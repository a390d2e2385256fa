"""CPU tests of what the GPU smoke (chip_smoke.py) and its helpers rely on:
the compile-cache rule, the refusal to run without a GPU, the exact
count comparison against the scalar oracle, and the multi-device dry run
on virtual CPU devices.  One `gpu` test repeats the toy comparison on a
card where there is one."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from query_oracle import oracle_classify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from __graft_entry__ import _toy_artifacts  # noqa: E402


def _clean_env(**extra):
    """This process's environment without what conftest.py forces (the CPU
    platform, 8 virtual devices) or a cache directory, plus `extra`."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "XLA_FLAGS")}
    env.update(extra)
    return env


_CACHE_PROBE = (
    "import json, jax; from cammiq_tpu.utils.jitcache import "
    "enable_persistent_cache; d = enable_persistent_cache(); "
    "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir_rule(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands;
    without it the cache is <checkout>/.jax_cache.  Two processes agree."""
    extra = {"JAX_PLATFORMS": "cpu"}
    if env_dir:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(REPO, ".jax_cache"))
    seen = []
    for cwd in (REPO, str(tmp_path)):
        r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=cwd,
                           env=_clean_env(PYTHONPATH=REPO, **extra),
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        seen.append(json.loads(r.stdout.strip().splitlines()[-1]))
    assert seen[0] == seen[1] == [want, want]


def test_smoke_refuses_without_gpu():
    """No GPU (JAX held to the CPU): the smoke exits non-zero and never
    prints its ok line."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_clean_env(JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _toy_counts():
    """A toy database queried through the product session, and the
    scalar oracle on the same reads, in the smoke's layout."""
    from cammiq_tpu.config import QueryConfig
    from cammiq_tpu.io.fastq import ReadSet
    from cammiq_tpu.query.pipeline import QuerySession

    art, rs, G = _toy_artifacts(num_genomes=6, glen=1500, seed=3)
    iu, idd = art.unique_index, art.doubly_index
    reads = ReadSet(codes=rs.codes, lengths=rs.lengths,
                    total_len=int(rs.lengths.sum()), name="toy")
    sess = QuerySession(iu, idd, G, QueryConfig(h=iu.h), engine="sortjoin")
    got = chip_smoke.counts_arrays("", sess.run(reads, sc_mode=True))
    got.update({k: v for k, v in chip_smoke.counts_arrays(
        "", sess.run(reads, sc_mode=False)).items() if k != "pairs"})
    o = oracle_classify(iu, idd, rs.codes, rs.lengths, G)
    return got, chip_smoke.oracle_layout(o, iu.num_entries, idd.num_entries)


@pytest.fixture(scope="module")
def toy_counts():
    return _toy_counts()


def test_compare_counts_accepts_oracle(toy_counts):
    got, want = toy_counts
    assert int(want["cnts_u"].sum() + want["cnts_d"].sum()) > 0
    assert len(want["pairs"]) > 0
    assert chip_smoke.compare_counts(got, want) == []


@pytest.mark.parametrize("key", chip_smoke.COUNT_KEYS)
def test_compare_counts_flags_one_perturbed_count(toy_counts, key):
    got, want = toy_counts
    bad = {k: np.array(v, copy=True) for k, v in got.items()}
    flat = bad[key].reshape(-1)
    flat[-1] += 1
    assert chip_smoke.compare_counts(bad, want) == [key]


def test_dryrun_multichip_on_virtual_cpu_devices():
    """The multi-device dry run on the 8 virtual CPU devices this suite
    forces (tests/conftest.py), with no fallback to another platform."""
    import jax

    import __graft_entry__

    assert len(jax.devices()) == 8 and jax.devices()[0].platform == "cpu"
    __graft_entry__.dryrun_multichip(8)


def test_dryrun_multichip_refuses_too_few_devices():
    import __graft_entry__

    with pytest.raises(ValueError, match="needs 16 devices"):
        __graft_entry__.dryrun_multichip(16)


_GPU_TOY = """
import json, sys
import jax
assert jax.devices()[0].platform == "gpu", jax.devices()
sys.path.insert(0, "tests")
import test_chip_smoke as t
got, want = t._toy_counts()
print(json.dumps(t.chip_smoke.compare_counts(got, want)))
"""


@pytest.mark.gpu
def test_toy_counts_on_gpu_equal_oracle(gpu_card):
    """The toy comparison on the card: the classify step as compiled for
    the GPU gives the oracle's counts exactly."""
    r = subprocess.run([sys.executable, "-c", _GPU_TOY], cwd=REPO,
                       env=_clean_env(PYTHONPATH=REPO), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("line,label", [
    ("26204 ms (0 persistent-cache hits)", "cold"),
    ("599 ms (2 persistent-cache hits)", "warm")])
def test_cache_label(line, label):
    assert chip_smoke.cache_label(line) == label
