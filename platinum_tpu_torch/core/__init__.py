"""Copies of the JAX package's host modules (platinum_tpu/core/), numpy only."""
