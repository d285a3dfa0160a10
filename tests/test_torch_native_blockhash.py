"""The port's C block-hash chain (dynamo_tpu_torch/native/) on the CPU.

Twins of tests/test_native_blockhash.py: the C digests equal
``hashlib.blake2b(digest_size=8)``'s over the same message (single blocks,
chains at block sizes 1-128 with and without a salt, a message over one
compression block), the dispatch is transparent and an out-of-bounds block
size takes the Python path. Also: the port's digests equal the JAX
package's ``dynamo_tpu.tokens`` ones on the same seeded inputs, both with
the C path and under ``DYN_NO_NATIVE``, and the library is built under
``build/native/`` with a content-keyed name. Skipped only where no C
compiler exists.
"""

import os
import random
import shutil

import numpy as np
import pytest

from dynamo_tpu import tokens as j_tokens
from dynamo_tpu_torch import native
from dynamo_tpu_torch.tokens import (
    TokenBlockSequence,
    _py_block_hash,
    _py_seq_hash_chain,
    compute_block_hash,
    compute_seq_hash_chain,
)

needs_native = pytest.mark.skipif(
    shutil.which(os.environ.get("CC", "cc")) is None, reason="no C compiler on this machine")


@pytest.fixture
def fresh_native(monkeypatch):
    """The module as at first use: the next call loads (or skips) again."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    return native


@needs_native
def test_native_library_loads_from_build_native():
    assert native.native_available()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert path.exists() and path.name.startswith("libblockhash-")
    # never beside the source
    assert not list(native._SRC.parent.glob("*.so"))


@needs_native
def test_single_block_parity():
    rng = random.Random(0)
    for _ in range(50):
        n = rng.randint(1, 64)
        toks = [rng.randint(0, 2**31 - 1) for _ in range(n)]
        parent = rng.randint(0, 2**64 - 1)
        salt = rng.choice([0, 1, rng.randint(0, 2**63)])
        assert native.block_hash(parent, toks, salt) == _py_block_hash(parent, toks, salt)


@needs_native
def test_chain_parity_all_block_sizes():
    rng = random.Random(1)
    for bs in (1, 4, 16, 64, 128):
        toks = [rng.randint(0, 2**31 - 1) for _ in range(bs * 7 + 3)]
        assert native.hash_chain(toks, bs) == _py_seq_hash_chain(toks, bs)
        assert native.hash_chain(toks, bs, salt=99) == _py_seq_hash_chain(toks, bs, salt=99)


@needs_native
def test_long_message_multi_compression_block():
    toks = list(range(1024))
    assert native.hash_chain(toks, 512) == _py_seq_hash_chain(toks, 512)


def test_dispatch_is_transparent():
    toks = list(range(40))
    assert compute_seq_hash_chain(toks, 16) == _py_seq_hash_chain(toks, 16)
    assert compute_block_hash(7, toks[:16], 3) == _py_block_hash(7, toks[:16], 3)


@needs_native
def test_out_of_bounds_block_size_falls_back():
    toks = list(range(4096))
    assert native.hash_chain(toks, 2048) is None
    assert compute_seq_hash_chain(toks, 2048) == _py_seq_hash_chain(toks, 2048)
    # an empty block, a salt past u64 and an id past u32 are out of bounds too
    assert native.block_hash(0, [], 0) is None
    assert native.block_hash(0, [1, 2], 1 << 64) is None
    assert native.hash_chain([1 << 32, 1], 2) is None


@needs_native
@pytest.mark.parametrize("no_native", [False, True])
def test_digests_equal_the_jax_package(fresh_native, monkeypatch, no_native):
    """The same seeded prompts through the port's dispatch (C, or Python
    under DYN_NO_NATIVE) and the JAX package's ``tokens``: equal chains,
    block hashes and incremental sequences."""
    if no_native:
        monkeypatch.setenv("DYN_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("DYN_NO_NATIVE", raising=False)
    assert fresh_native.native_available() is not no_native
    rng = np.random.default_rng(19)
    for bs in (1, 4, 16, 64):
        for _ in range(8):
            toks = rng.integers(0, 128256, size=int(rng.integers(0, 12 * bs + 5))).tolist()
            salt = int(rng.integers(0, 2**63))
            assert compute_seq_hash_chain(toks, bs) == j_tokens.compute_seq_hash_chain(toks, bs)
            assert (compute_seq_hash_chain(toks, bs, salt)
                    == j_tokens.compute_seq_hash_chain(toks, bs, salt))
            parent = int(rng.integers(0, 2**63))
            if toks[:bs]:
                assert (compute_block_hash(parent, toks[:bs], salt)
                        == j_tokens.compute_block_hash(parent, toks[:bs], salt))
            assert (TokenBlockSequence(toks, bs).block_hashes()
                    == j_tokens.TokenBlockSequence(toks, bs).block_hashes())


def test_no_native_takes_the_python_path(fresh_native, monkeypatch):
    monkeypatch.setenv("DYN_NO_NATIVE", "1")
    assert not fresh_native.native_available()
    assert fresh_native.block_hash(0, [1, 2, 3]) is None
    assert fresh_native.hash_chain(list(range(32)), 16) is None
    toks = list(range(100))
    assert compute_seq_hash_chain(toks, 16) == _py_seq_hash_chain(toks, 16)


def test_failed_build_is_logged_once_and_falls_back(fresh_native, monkeypatch, tmp_path, caplog):
    """A compiler that fails: one WARNING carrying its message, the Python
    path after it, no second build attempt."""
    monkeypatch.delenv("DYN_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    bad_cc = tmp_path / "bad-cc"
    bad_cc.write_text("#!/bin/sh\necho 'bad-cc: no such target' >&2\nexit 1\n")
    bad_cc.chmod(0o755)
    monkeypatch.setenv("CC", str(bad_cc))
    with caplog.at_level("WARNING", logger="dynamo_tpu_torch.native"):
        assert not fresh_native.native_available()
        assert not fresh_native.native_available()
        toks = list(range(48))
        assert compute_seq_hash_chain(toks, 16) == _py_seq_hash_chain(toks, 16)
    warned = [r for r in caplog.records if r.name == "dynamo_tpu_torch.native"]
    assert len(warned) == 1 and "bad-cc: no such target" in warned[0].getMessage()
    assert not list((tmp_path / "build" / "native").glob("*"))
