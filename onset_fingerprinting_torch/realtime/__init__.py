"""The realtime serving path: the per-block engine on the card, its
classifier, and the location-triggered actions (port of
``onset_fingerprinting_tpu.realtime``)."""
