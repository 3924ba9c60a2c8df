"""Inputs and tolerances shared by ``chip_smoke.py`` and the tests."""
