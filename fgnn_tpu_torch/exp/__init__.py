"""The experiment runners (port of the repo's ``exp/``), run as
``python -m fgnn_tpu_torch.exp.<runner>`` or ``make -C fgnn_tpu_torch/exp
<runner>.run``."""
