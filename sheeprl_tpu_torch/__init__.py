"""PyTorch/CUDA port of sheeprl_tpu: DreamerV3 and Dream-and-Ponder training,
checkpoints and evaluation.

The JAX package ``sheeprl_tpu`` is the reference; this package imports nothing
from it. Run ``python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy ...``
(or ``exp=dream_and_ponder``) to train and ``python -m sheeprl_tpu_torch.eval
checkpoint_path=<ckpt>`` to evaluate.
"""
