"""The port's engine against the reference's on ``gru-rnnt-smoke``.

The cases of ``test_torch_engine.py`` (which runs them on
``lstm-rnnt-smoke``), for the single-leaf GRU state.  A file of its own so
that the two cells' reference engines compile in parallel test workers.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_engine import (CASES, case_id, check_engine_case,  # noqa: E402
                               check_export_adopt, check_state_bytes)

ARCH = "gru-rnnt"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gru_engine_matches_reference_and_decode_single(case):
    check_engine_case(ARCH, case)


def test_gru_state_bytes_per_stream_match_reference():
    check_state_bytes(ARCH)


def test_gru_export_adopt_round_trip_is_bitexact():
    check_export_adopt(ARCH)
