"""``python -m sheeprl_tpu_torch.eval checkpoint_path=<ckpt> [key=value ...]``:
evaluate a DreamerV3 or Dream-and-Ponder checkpoint of either package
(:func:`sheeprl_tpu_torch.cli.evaluation`)."""

import sys

from sheeprl_tpu_torch.cli import eval_main

if __name__ == "__main__":
    sys.exit(eval_main())
