"""Onset detectors."""
