"""Data: the synthetic modal-drum sessions, frame extraction and the MCPOSD
location dataset."""
