"""Copies of the JAX package's host modules (platinum_tpu/app/), numpy only,
and the port's command-line interface (cli.py)."""
