"""Sampling, dedup, planning and extraction ops; the Hopper row gather."""
from .hashtable import lookup_local_ids, unique_and_remap, unique_with_seeds
from .padding import SamplePlan, make_plan
from .sampling import multi_layer_sample, sample_layer
