"""repro_torch paper-format string tokens against the JAX package.

The strings are held equal, character for character: the paper's own
§2.2.1 examples (as ``tests/test_encoding.py`` pins them) and random
vectors under every encoder and filter.
"""

import numpy as np
import pytest

from repro.core import encoding as jenc
from repro.core import filtering as jfilt
from repro.core.tokens import tokens_for_vector as jax_tokens
from repro_torch.core import encoding as tenc
from repro_torch.core import filtering as tfilt
from repro_torch.core.tokens import encode_value, tokens_for_vector

W = np.array([0.12, -0.13, 0.065])


def test_paper_examples():
    assert tokens_for_vector(W, tenc.RoundingEncoder(2)) == [
        "0P2i0d12", "1P2ineg0d13", "2P2i0d07"]
    assert tokens_for_vector(W, tenc.IntervalEncoder(0.1)) == [
        "0I10i0d1", "1I10ineg0d2", "2I10i0d0"]
    enc = tenc.CombinedEncoder(tenc.RoundingEncoder(3),
                               tenc.IntervalEncoder(0.2))
    assert tokens_for_vector(W, enc) == [
        "0P3i0d120", "1P3ineg0d130", "2P3i0d065",
        "0I5i0d0", "1I5ineg0d2", "2I5i0d0"]
    assert tokens_for_vector(W, tenc.RoundingEncoder(2),
                             trim=tfilt.TrimFilter(0.1)) == [
        "0P2i0d12", "1P2ineg0d13"]
    assert tokens_for_vector(W, tenc.RoundingEncoder(2),
                             best=tfilt.BestFilter(1)) == ["1P2ineg0d13"]
    assert encode_value("-0.2") == "ineg0d2"


ENCODERS = [
    ("P2", tenc.RoundingEncoder(2), jenc.RoundingEncoder(2)),
    ("P1", tenc.RoundingEncoder(1), jenc.RoundingEncoder(1)),
    ("I10", tenc.IntervalEncoder(0.1), jenc.IntervalEncoder(0.1)),
    ("I20", tenc.IntervalEncoder(0.05), jenc.IntervalEncoder(0.05)),
    ("P3+I5", tenc.CombinedEncoder(), jenc.CombinedEncoder()),
    ("P1+I10", tenc.CombinedEncoder(tenc.RoundingEncoder(1),
                                    tenc.IntervalEncoder(0.1)),
     jenc.CombinedEncoder(jenc.RoundingEncoder(1),
                          jenc.IntervalEncoder(0.1)))]
FILTERS = [(None, None, None, None),
           (tfilt.TrimFilter(0.05), None, jfilt.TrimFilter(0.05), None),
           (None, tfilt.BestFilter(7), None, jfilt.BestFilter(7))]


@pytest.mark.parametrize("filters", FILTERS, ids=["none", "trim", "best"])
@pytest.mark.parametrize("name,tenc_,jenc_", ENCODERS,
                         ids=[e[0] for e in ENCODERS])
def test_random_vectors_equal_strings(name, tenc_, jenc_, filters):
    t_trim, t_best, j_trim, j_best = filters
    rng = np.random.default_rng(len(name))
    for _ in range(20):
        x = rng.normal(size=24)
        x = (x / np.linalg.norm(x)).astype(np.float32)
        x[rng.integers(0, 24)] = rng.choice([0.1, -0.2, 0.05, 0.065])
        assert tokens_for_vector(x, tenc_, t_trim, t_best) == \
            jax_tokens(x, jenc_, j_trim, j_best)
