"""Configuration tree (a jax-free copy of ``onset_fingerprinting_tpu.core.config``)."""
