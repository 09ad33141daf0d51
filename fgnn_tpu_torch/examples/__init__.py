"""The training apps (port of the repo's ``examples/``), run as
``python -m fgnn_tpu_torch.examples.<app>``."""
