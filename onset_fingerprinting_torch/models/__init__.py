"""Fingerprint models and the flax-params importer."""
