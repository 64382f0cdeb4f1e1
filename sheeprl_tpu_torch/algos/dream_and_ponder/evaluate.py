"""Dream-and-Ponder evaluation (counterpart of
sheeprl_tpu/algos/dream_and_ponder/evaluate.py): the DreamerV3 evaluation with
the ponder actor."""

from __future__ import annotations

from typing import Any, Dict, Mapping

from sheeprl_tpu_torch.algos.dream_and_ponder.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate_player
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="dream_and_ponder")
def evaluate(runtime, cfg, state: Mapping[str, Any]) -> Dict[str, Any]:
    roots = flax_params.ponder_actor_roots(int(cfg.algo.actor.mlp_layers))
    return evaluate_player(runtime, cfg, state, build_agent, roots)
