"""``python3 -m dnnpde_tpu_torch``: the command-line interface
(``dnnpde_tpu_torch/cli.py``)."""

from dnnpde_tpu_torch.cli import main

raise SystemExit(main())
