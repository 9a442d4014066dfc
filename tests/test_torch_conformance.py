"""The port's conformance fuzz and its brute-force oracles.

``columba_tpu_torch/tools/oracle.py`` holds the port's own copies of the JAX
package's test oracles, so that ``tools/fuzz_conformance.py`` runs on the
card, where there is no JAX. Here they must equal the JAX tests' versions
(``tests/test_pipeline.py`` ``brute_hamming`` / ``brute_edit_ends``,
``tests/conftest.py`` ``make_genome``) on the genomes and reads of four fuzz
draws, under both metrics; and the fuzz itself, on the plain versions
(``--device cpu``), must find no failure and no crash in its first two seeds'
four trials.
"""

import numpy as np
import pytest
import torch

from columba_tpu.core import alphabet as jalphabet
from columba_tpu_torch.tools import fuzz_conformance, oracle

from tests.conftest import make_genome as jmake_genome
from tests.test_pipeline import brute_edit_ends as jbrute_edit_ends
from tests.test_pipeline import brute_hamming as jbrute_hamming

torch.set_num_threads(1)


def _draws(seed):
    """A fuzz seed's genome, from both packages' ``make_genome``, and its
    two trials' draws."""
    rng = np.random.default_rng(1000 + seed)
    jrng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(5000, 40000))
    assert int(jrng.integers(5000, 40000)) == n
    g = oracle.make_genome(rng, n)
    np.testing.assert_array_equal(g, jmake_genome(jrng, n))
    return g, [fuzz_conformance.draw_trial(rng, g)
               for _ in range(fuzz_conformance.TRIALS)]


@pytest.mark.parametrize("seed", [0, 1])
def test_oracles_equal_jax_tests(seed):
    """Both oracles equal the JAX tests' on every read and strand of a
    seed's two draws, each draw under both metrics, at its k and at k + 2
    (more hits, ties and runs of equal distances)."""
    g, trials = _draws(seed)
    hits = 0
    for tr in trials:
        for r in tr["reads"]:
            for rr in (r, jalphabet.revcomp(r)):
                for k in (tr["k"], tr["k"] + 2):
                    ham = oracle.brute_hamming(g, rr, k)
                    ends = oracle.brute_edit_ends(g, rr, k)
                    assert ham == jbrute_hamming(g, rr, k)
                    assert ends == jbrute_edit_ends(g, rr, k)
                    hits += len(ham) + len(ends)
    assert hits > 0


def test_fuzz_plain_versions():
    """The port's fuzz on the CPU (the plain versions): two seeds, four
    trials, no failure and no crash."""
    assert fuzz_conformance.main(["--device", "cpu", "--seeds", "2"]) == (
        4, 0, 0)
