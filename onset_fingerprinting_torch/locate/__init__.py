"""Localization: lag maps, TDOA trilateration and the online locators
(port of ``onset_fingerprinting_tpu.locate``)."""
