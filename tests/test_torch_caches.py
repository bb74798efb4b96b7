"""The port's host caches and native xxhash (``nuzero_tpu_torch/utils/caches.py``,
``nuzero_tpu_torch/native``), mirroring ``tests/test_caches.py`` and held
against the JAX package's: the same digests as ``nuzero_tpu.native`` on
random records, the port's native and pure-Python hashes bit-equal, and the
same cache keys and keyless slots for the same positions (all exact)."""

import numpy as np
import pytest
import torch

from nuzero_tpu import native as jax_native
from nuzero_tpu.utils import caches as jax_caches
from nuzero_tpu_torch import native
from nuzero_tpu_torch.native import load, xxh64, xxh64_py
from nuzero_tpu_torch.utils.caches import DictCache, KeylessCache, _state_bytes, create_cache

# Official xxHash64 test vectors (seed 0).
VECTORS = [(b"", 0xEF46DB3751D8E999), (b"a", 0xD24EC4F1A98C6E5B), (b"abc", 0x44BC2CF5AD770999)]


def test_native_library_is_the_ports_own():
    assert load() is not None, "g++ is installed here: the native hash must build"
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and "nuzero_tpu_torch" in path
    assert "nuzero_tpu/native" not in load()._name


@pytest.mark.parametrize("hash_fn", [xxh64, xxh64_py])
def test_xxh64_known_vectors(hash_fn):
    for data, digest in VECTORS:
        assert hash_fn(data) == digest


def test_native_and_pure_hashes_equal_jax_on_random_records():
    """Records of every length 0-100 (each branch of the algorithm: the
    32-byte stripes, 8- and 4-byte words, single bytes) and seeds."""
    rng = np.random.default_rng(0)
    for n in range(101):
        data = rng.integers(0, 256, n, np.uint8).tobytes()
        seed = int(rng.integers(0, 2**63))
        want = jax_native.xxh64(data, seed)
        assert xxh64(data, seed) == xxh64_py(data, seed) == want, n


def test_pure_hash_without_the_library(monkeypatch):
    """A host without g++ hashes in pure Python, to the same digests."""
    data = np.random.default_rng(1).integers(0, 255, 37, np.uint8).tobytes()
    want = xxh64(data)
    monkeypatch.setattr(native, "load", lambda: None)
    assert native.xxh64(data) == want


@pytest.mark.parametrize("cls", [DictCache, KeylessCache])
def test_cache_roundtrip(cls):
    cache = cls(64)
    s = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert cache.get(s) is None
    cache.put((s, ("policy", 0.5)))
    assert cache.get(s) == ("policy", 0.5)
    assert cache.hits == 1 and cache.misses == 1
    assert cache.length() == 1
    # A tensor of the same values is the same key.
    assert cache.get(torch.from_numpy(s)) == ("policy", 0.5)


def test_keyless_no_keys_stored():
    cache = KeylessCache(64)
    assert cache.size == 64  # power-of-2 sizing
    s1 = np.ones((2, 2), np.float32)
    s2 = np.zeros((2, 2), np.float32)
    cache.put((s1, "a"))
    cache.put((s2, "b"))
    assert cache.get(s1) == "a"
    assert cache.get(s2) == "b"


def test_keyless_merge():
    a, b = KeylessCache(32), KeylessCache(32)
    s = np.full((2,), 3.0, np.float32)
    b.put((s, "v"))
    a.update(b)
    assert a.get(s) == "v"


def test_dict_cache_eviction():
    cache = DictCache(10)
    for i in range(12):
        cache.put((np.full(4, i, np.float32), i))
    assert cache.length() <= 10


def test_factory():
    assert isinstance(create_cache("dict", 10), DictCache)
    assert isinstance(create_cache("keyless", 10), KeylessCache)
    assert create_cache("disabled", 10) is None
    with pytest.raises(ValueError):
        create_cache("bogus", 10)


def test_keys_equal_jax_on_random_positions():
    """The observations of random SCS and TTT positions in each package:
    the port's key of its tensor is JAX's key of its array, and a keyless
    cache of each puts the position in the same slot with the same
    identifier.  JAX's observation is its jit-compiled one, which the port
    reproduces bit for bit (x / const compiled as x * (1 / const)); JAX's
    eager ``observe`` divides, and its reinforcement channels may differ by
    one ulp from its own compiled ones."""
    import jax
    import jax.numpy as jnp

    import run as jax_runner
    from nuzero_tpu_torch import run as runner

    rng = np.random.default_rng(0)
    port_cache, jax_cache = KeylessCache(4096), jax_caches.KeylessCache(4096)
    for env_args in (("ttt",), ("scs", "open_field_5.yml")):
        if env_args[0] == "ttt":
            jenv, env = jax_runner._ttt_env(), runner._ttt_env("cpu")
        else:
            jenv, env = jax_runner._scs_env(env_args[1]), runner._scs_env(env_args[1],
                                                                          device="cpu")
        jstep, jobserve = jax.jit(jenv.step), jax.jit(jenv.observe)
        for game in range(3):
            js, ts = jenv.init(None), env.init(1)
            for _ in range(6):
                jobs, obs = np.asarray(jobserve(js)), env.observe(ts)[0]
                assert _state_bytes(obs) == jax_caches._state_bytes(jobs)
                assert port_cache._locate(obs) == jax_cache._locate(jobs)
                if bool(jenv.terminal(js)):
                    break
                a = int(rng.choice(np.flatnonzero(np.asarray(jenv.legal_mask(js)))))
                js = jstep(js, jnp.int32(a))
                ts = env.step(ts, torch.tensor([a], dtype=torch.int32))
