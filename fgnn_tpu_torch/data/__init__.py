"""Datasets: schema, synthetic generator, mmap loader (the port's copies of
``fgnn_tpu/data``)."""
from .loader import load_cache_ranking, load_dataset, parse_meta
from .schema import Dataset
from .synthetic import build_alias_tables, make_synthetic_dataset, write_dataset
