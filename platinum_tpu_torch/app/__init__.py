"""Copies of the JAX package's host modules (platinum_tpu/app/), numpy only."""
