"""Dream-and-Ponder utilities (counterpart of
sheeprl_tpu/algos/dream_and_ponder/utils.py): the DreamerV3 ones."""

from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test  # noqa: F401
