"""Transforms and multi-scalar multiplication: NTT, MSM, commit pipeline."""
