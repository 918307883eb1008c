"""One slot hash for both packages in a CPU differential.

The slot hash picks every key's bucket, so the port and the JAX package
agree on store bytes only when both hash with the same function. The
port hashes native XXH64 wherever g++ builds its library, the JAX
package blake2b-8 wherever its own library is not built (the CPU test
runs build only the port's). `pin_hash(mp, "blake2b")` puts both (and the port's GEB client) on
blake2b-8; `pin_hash(mp, "xxh64")` puts both on the port's native XXH64,
handing its `hash_batch` to the JAX package's selection. Nothing is
built inside gubernator_tpu/. The other differentials import `pin_hash`
from here; the tests below hold the pin itself.
"""

import pytest

import gubernator_tpu.core.hashing as j_hashing
import gubernator_tpu_torch.client_geb as t_client
import gubernator_tpu_torch.core.hashing as t_hashing
from gubernator_tpu_torch.native import load_hashlib

HASHES = ("blake2b", "xxh64")


def pin_hash(mp, which: str) -> None:
    """Pin both packages' slot hash (and the port's client hash) to
    `which`, through their lazy selections' module globals."""
    assert which in HASHES, which
    batch = None
    if which == "xxh64":
        hn = load_hashlib()
        assert hn is not None, "the port's native hasher did not build"
        batch = hn.hash_batch
    for mod in (j_hashing, t_hashing):
        mp.setattr(mod, "_native_checked", True)
        mp.setattr(mod, "_native_batch", batch)
    mp.setattr(t_client, "_hash_checked", True)
    mp.setattr(t_client, "_hash_batch", batch)


@pytest.mark.parametrize("which", HASHES)
def test_pin_puts_both_packages_and_the_client_on_one_hash(which, monkeypatch):
    pin_hash(monkeypatch, which)
    keys = [f"name_{i}_k{i}" for i in range(200)] + ["", "ünï_cødé"]
    port = t_hashing.slot_hash_batch(keys)
    assert (port == j_hashing.slot_hash_batch(keys)).all()
    assert (port == t_client.client_hash_batch(keys)).all()
    xxh64 = which == "xxh64"
    assert t_hashing.using_native_hash() == j_hashing.using_native_hash() == xxh64
    assert t_client.client_hash_is_native() == xxh64
    if not xxh64:  # blake2b-8: the pure-Python hash of both packages
        assert (port == j_hashing._slot_hash_batch_py(keys)).all()


def test_the_two_hashes_differ():
    """The pin matters: one key lands in a different bucket on each."""
    hn = load_hashlib()
    keys = [f"k{i}" for i in range(64)]
    assert (hn.hash_batch(keys) != t_hashing._slot_hash_batch_py(keys)).all()
