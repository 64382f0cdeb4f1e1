"""PyTorch/CUDA port of sheeprl_tpu (first slice: DreamerV3 training).

The JAX package ``sheeprl_tpu`` is the reference; this package imports nothing
from it. Run ``python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy ...``.
"""
