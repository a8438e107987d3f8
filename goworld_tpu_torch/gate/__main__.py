"""``python -m goworld_tpu_torch.gate`` — gate process binary."""

import sys

from goworld_tpu_torch.gate import run

sys.exit(run())
