"""The systems under test, one module per configuration's "system"."""
