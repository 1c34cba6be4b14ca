"""The port's native envelope codec and CRC32C (native/envelope.cpp and
native/crc32c.cpp, built by storage_engine/_native.py into build/native/)
against the port's pure-Python pair and the JAX package.

The cases of tests/test_serialize_native.py on the port: the C codec is
byte for byte the Python encode_value/decode_value over the tagged
grammar and every registered message, and the public pair dispatches to
it (the Python pair is reached only by an explicit monkeypatch). Then:
frames byte-equal to the JAX package's encode_message for every message
both packages register; both packages' envelopes loaded in one process,
each decoding into its own classes; the native CRC equal to the table
walk; and a failed build raises.
"""

from __future__ import annotations

import dataclasses
import random
import zlib

import pytest

# The role/cluster modules register their messages on import, so the
# sweeps below see the full registries of both packages.
import foundationdb_tpu.cluster.commit_wire  # noqa: F401
import foundationdb_tpu.cluster.multiprocess  # noqa: F401
import foundationdb_tpu_torch.cluster.commit_wire  # noqa: F401
import foundationdb_tpu_torch.cluster.multiprocess  # noqa: F401
from foundationdb_tpu.core import serialize as JS
from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.core import serialize as S
from foundationdb_tpu_torch.core.errors import error_for_code
from foundationdb_tpu_torch.storage_engine import _native


def _py_encode(v) -> bytes:
    w = S.BinaryWriter()
    S._encode_value_py(w, v)
    return w.to_bytes()


def _py_decode(blob: bytes):
    return S._decode_value_py(S.BinaryReader(blob))


def _rand_value(rng: random.Random, depth: int = 0):
    kinds = ["none", "bool", "int", "bigint", "float", "bytes", "str",
             "err"]
    if depth < 3:
        kinds += ["list", "tuple", "dict"] * 2
    k = rng.choice(kinds)
    if k == "none":
        return None
    if k == "bool":
        return rng.random() < 0.5
    if k == "int":
        return rng.randint(-(2**63), 2**63 - 1)
    if k == "bigint":
        return rng.choice([1, -1]) * rng.randint(2**63, 2**100)
    if k == "float":
        return rng.uniform(-1e12, 1e12)
    if k == "bytes":
        return bytes(rng.randrange(256) for _ in range(rng.randrange(24)))
    if k == "str":
        return "".join(rng.choice("abc\x00é中 🙂") for _ in
                       range(rng.randrange(16)))
    if k == "err":
        return error_for_code(rng.choice([1007, 1020, 1500]))("boom")
    if k == "list":
        return [_rand_value(rng, depth + 1) for _ in range(rng.randrange(5))]
    if k == "tuple":
        return tuple(_rand_value(rng, depth + 1)
                     for _ in range(rng.randrange(5)))
    return {f"k{i}": _rand_value(rng, depth + 1)
            for i in range(rng.randrange(5))}


def _instantiate(cls):
    """Build a registered message with defaults where declared and
    plausible wire-type values elsewhere (None if the ctor refuses). The
    draws depend on the class name only, so both packages' classes of
    one name get the same values."""
    rng = random.Random(zlib.crc32(cls.__name__.encode()))
    pool = [0, -1, 2**40, 1.5, b"key", b"", "s", None, True,
            [1, b"x"], (2, 3), {"a": 1}]
    try:
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                kwargs[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                kwargs[f.name] = f.default_factory()
            else:
                kwargs[f.name] = rng.choice(pool)
        return cls(**kwargs)
    except Exception:
        return None


def test_native_matches_python_on_random_values():
    rng = random.Random(20260807)
    env = S._env_init()
    for _ in range(1500):
        v = _rand_value(rng)
        a = _py_encode(v)
        assert env.encode_value(v) == a, v
        got, pos = env.decode_value(a, 0)
        assert pos == len(a)
        # Errors don't compare equal; re-encoding is the identity check.
        assert _py_encode(got) == _py_encode(_py_decode(a)) == a, v


def test_native_matches_python_on_every_registered_message():
    env = S._env_init()
    covered = 0
    for name in sorted(S._MESSAGES):
        inst = _instantiate(S._MESSAGES[name])
        if inst is None:
            continue
        a = _py_encode(inst)
        assert env.encode_value(inst) == a, name
        got, pos = env.decode_value(a, 0)
        assert pos == len(a), name
        assert type(got) is S._MESSAGES[name], name
        assert _py_encode(got) == a, name
        covered += 1
    # The sweep must actually exercise the registry, not vacuously pass.
    assert covered >= 0.8 * len(S._MESSAGES), (covered, len(S._MESSAGES))


def test_native_enum_and_error_decode_semantics():
    env = S._env_init()
    for ecls in S._ENUMS.values():
        for member in ecls:
            blob = _py_encode(member)
            assert env.encode_value(member) == blob
            got, _ = env.decode_value(blob, 0)
            assert got is member or got == member
    err = error_for_code(1020)("not committed")
    got, _ = env.decode_value(_py_encode(err), 0)
    assert type(got) is type(err) and str(got) == str(err)


def test_native_truncation_and_type_errors_match():
    env = S._env_init()
    blob = _py_encode([1, "x", b"y"])
    for cut in range(len(blob)):
        with pytest.raises(ValueError):
            env.decode_value(blob[:cut] if cut else b"", 0)

    class NotWire:
        pass

    with pytest.raises(TypeError):
        env.encode_value(NotWire())
    with pytest.raises(TypeError):
        _py_encode(NotWire())


def test_dispatch_reaches_python_only_when_patched(monkeypatch):
    """The public pair runs the extension; with it patched out it runs
    the Python oracle, and both give the same bytes, so mixed
    deployments interoperate."""
    msg = {"k": [1, b"v", (True, None)], "n": 2**70}
    S._env_init()
    w = S.BinaryWriter()
    S.encode_value(w, msg)
    native_blob = w.to_bytes()
    assert S._ENV is _native.load_envelope()
    monkeypatch.setattr(S, "_ENV", None)
    monkeypatch.setattr(S, "_ENV_INIT", True)
    w = S.BinaryWriter()
    S.encode_value(w, msg)
    blob = w.to_bytes()
    assert blob == _py_encode(msg) == native_blob
    assert S.decode_value(S.BinaryReader(blob)) == msg


def test_dispatch_uses_python_for_non_bytes_buffers():
    """BinaryReader over a bytearray stays on the Python decoder (the C
    path is gated on a plain bytes buffer) — same result either way."""
    blob = _py_encode({"a": 1})
    r = S.BinaryReader(blob)
    via_bytes = S.decode_value(r)
    r2 = S.BinaryReader(blob)
    r2._buf = bytearray(blob)
    assert S.decode_value(r2) == via_bytes == {"a": 1}


def test_encode_message_roundtrip_via_native():
    from foundationdb_tpu_torch.cluster.multiprocess import TLogPeekRequest

    inst = _instantiate(TLogPeekRequest)
    blob = S.encode_message(inst)
    back = S.decode_message(blob)
    assert type(back) is TLogPeekRequest
    assert _py_encode(back) == _py_encode(inst)


def _same_message(jcls, pcls):
    """The two packages' classes of one name with the same field names."""
    return ([f.name for f in dataclasses.fields(jcls)]
            == [f.name for f in dataclasses.fields(pcls)])


def test_frames_equal_the_jax_packages_for_every_shared_message():
    """encode_message of a message both packages register gives the same
    frame in both (each package through its own envelope), and each
    package decodes the other's frame into its own class."""
    shared = sorted(set(S._MESSAGES) & set(JS._MESSAGES))
    assert len(shared) >= 0.9 * len(S._MESSAGES), (
        len(shared), len(S._MESSAGES))
    covered = 0
    for name in shared:
        jcls, pcls = JS._MESSAGES[name], S._MESSAGES[name]
        if not _same_message(jcls, pcls):
            continue
        jinst, pinst = _instantiate(jcls), _instantiate(pcls)
        if jinst is None or pinst is None:
            continue
        frame = S.encode_message(pinst)
        assert frame == JS.encode_message(jinst), name
        assert type(S.decode_message(frame)) is pcls, name
        assert type(JS.decode_message(frame)) is jcls, name
        covered += 1
    assert covered >= 0.8 * len(shared), (covered, len(shared))


def test_both_envelopes_in_one_process_keep_their_own_registries():
    """The JAX package's envelope (native/fdbtpu_envelope.so) and the
    port's (build/native/) are two modules with two sets of C statics:
    after both are set up, each decodes into its own package's classes."""
    from foundationdb_tpu.cluster.multiprocess import (
        TLogPeekRequest as JPeek,
    )
    from foundationdb_tpu_torch.cluster.multiprocess import (
        TLogPeekRequest as PPeek,
    )

    penv = S._env_init()
    jenv = JS._env_init()
    if jenv is None:
        pytest.skip("the JAX package's envelope is not built")
    penv = S._env_init()  # set up again after the JAX package's
    assert penv is not jenv
    assert penv.__file__ != jenv.__file__
    assert "/native/fdbtpu_envelope.so" not in penv.__file__
    frame = S.encode_message(_instantiate(PPeek))
    assert frame == JS.encode_message(_instantiate(JPeek))
    jenv = JS._env_init()  # ...and the JAX package's last
    p_back, _ = penv.decode_value(frame, 8)
    j_back, _ = jenv.decode_value(frame, 8)
    assert type(p_back) is PPeek and type(j_back) is JPeek
    assert type(S.decode_message(frame)) is PPeek
    assert type(JS.decode_message(frame)) is JPeek


@pytest.mark.parametrize("size", [0, 1, 9, 4096, 65537])
def test_native_crc32c_equals_the_table_walk(size):
    data = bytes(random.Random(size).randrange(256) for _ in range(size))
    want = S._crc32c_py(data)
    assert native.crc32c(data) == S.crc32c(data) == want
    assert S.crc32c(data, 0x1234) == S._crc32c_py(data, 0x1234)
    assert S.crc32c(b"123456789") == 0xE3069283  # the check value


def test_a_failed_envelope_build_raises(tmp_path, monkeypatch):
    """No g++ on PATH and nothing built: loading the envelope and the CRC
    raises, naming g++; nothing falls back to the Python codec."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_native, "_envelope", None)
    monkeypatch.setattr(_native, "_host", None)
    monkeypatch.setattr(native, "_crc", None)
    monkeypatch.setattr(S, "_ENV", None)
    monkeypatch.setattr(S, "_ENV_INIT", False)
    monkeypatch.setattr(S, "_CRC", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        S.encode_message({"a": 1})
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        S.crc32c(b"x")
    assert not (tmp_path / "out").exists()
