"""Measurement tools of the port, named after the ``tools/`` scripts of the
JAX package that they port."""
