"""``python -m dnnpde_tpu_torch.bench``: the bench line of the port."""

import sys

from dnnpde_tpu_torch.bench import main

sys.exit(main())
