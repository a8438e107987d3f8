"""``python -m goworld_tpu_torch.dispatcher`` — dispatcher process binary."""

import sys

from goworld_tpu_torch.dispatcher import run

sys.exit(run())
