"""Sampling, dedup, planning and extraction ops; the Hopper row gather."""
