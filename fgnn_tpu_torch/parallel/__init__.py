"""Batch order and the multi-device engines: the shufflers, the role
device lists (``mesh``), arch5 and arch6 (``factored``), the balance
switcher (``switcher``) and the async trainers (``async_dp``)."""
