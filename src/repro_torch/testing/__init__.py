"""Inputs shared by ``chip_smoke.py`` and the ``gpu``-marked tests."""
