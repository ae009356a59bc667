"""The port's C ABI library (``build/capi_torch/libminigpt4_torch.so``,
built with g++ from ``minigpt4_tpu_torch/c_api/``), modelled on
tests/test_capi.py and tests/test_reference_bindings.py: its 18 exports
and header, a full chat through ctypes on the CPU (``MINIGPT4_TPU_DEVICE=
cpu``) whose text equals the port engine's, ``examples/main.c`` compiled
against it, the error strings, EOS functions and failure codes of the JAX
package's library, a quantized file byte-equal to the JAX quantizer's, and
the options the port refuses.
"""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import build_tiny_models, ensure_capi_lib
from minigpt4_tpu.quantize import quantize_model as jax_quantize_model
from minigpt4_tpu.utils import error_code_to_string as jax_error_string
from minigpt4_tpu_torch.c_api import _build
from minigpt4_tpu_torch.engine import MiniGPT4Engine, SamplingParams

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HEADER = ROOT / "minigpt4_tpu_torch" / "c_api" / "minigpt4.h"
GREEDY = (0.0, 40, 0.9, 1.0, 1.0, 64, 1.1, 1.0, 1.0, 0, 5.0, 1.0, 1)  # examples/main.c's knobs


class CImage(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("channels", ctypes.c_int), ("format", ctypes.c_int)]


class CEmbedding(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_float)), ("elements", ctypes.c_size_t)]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The reference bindings' argument types (minigpt4_library.py)."""
    p, i, f, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_char_p
    lib.minigpt4_model_load.restype = p
    lib.minigpt4_model_load.argtypes = [s, s, i, i, i, i, ctypes.c_bool]
    lib.minigpt4_image_load_from_file.argtypes = [p, s, ctypes.POINTER(CImage), i]
    lib.minigpt4_preprocess_image.argtypes = [p, ctypes.POINTER(CImage), ctypes.POINTER(CImage), i]
    lib.minigpt4_encode_image.argtypes = [p, ctypes.POINTER(CImage), ctypes.POINTER(CEmbedding),
                                          ctypes.c_size_t]
    lib.minigpt4_begin_chat_image.argtypes = [p, ctypes.POINTER(CEmbedding), s, ctypes.c_size_t]
    end = [p, ctypes.POINTER(s), ctypes.c_size_t, f, ctypes.c_int32, f, f, f, ctypes.c_int32,
           f, f, f, i, f, f, i]
    lib.minigpt4_end_chat_image.argtypes = end
    lib.minigpt4_end_chat.argtypes = end
    lib.minigpt4_begin_chat.argtypes = [p, s, ctypes.c_size_t]
    lib.minigpt4_system_prompt.argtypes = [p, ctypes.c_size_t]
    lib.minigpt4_reset_chat.argtypes = [p]
    lib.minigpt4_free.argtypes = [p]
    lib.minigpt4_free_image.argtypes = [ctypes.POINTER(CImage)]
    lib.minigpt4_free_embedding.argtypes = [ctypes.POINTER(CEmbedding)]
    lib.minigpt4_error_code_to_string.restype = s
    lib.minigpt4_error_code_to_string.argtypes = [i]
    lib.minigpt4_contains_eos_token.argtypes = [s]
    lib.minigpt4_is_eos.argtypes = [s]
    lib.minigpt4_quantize_model.argtypes = [s, s, i]
    return lib


@pytest.fixture(scope="module")
def lib():
    return _bind(ctypes.CDLL(str(_build.build())))


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's library where cmake can build it, else None."""
    path = ensure_capi_lib()
    return _bind(ctypes.CDLL(str(path))) if path else None


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return build_tiny_models(tmp_path_factory.mktemp("torch_capi"))


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("MINIGPT4_TPU_DEVICE", "cpu")


def _engine_tokens(model, llm, n_ctx, n_batch, question, n_tokens, pixels) -> list[str]:
    """The port engine's first ``n_tokens`` greedy tokens (end_chat, one
    at a time) after an image turn on ``pixels``."""
    eng = MiniGPT4Engine(model, llm, n_ctx=n_ctx, n_batch=n_batch, device="cpu")
    try:
        emb = eng.encode_image(pixels)
        eng.system_prompt()
        eng.begin_chat_image(emb, question)
        return [eng.end_chat(SamplingParams(temp=0.0)) for _ in range(n_tokens)]
    finally:
        eng.close()


def _streamed(tokens: list[str]) -> str:
    """What examples/main.c prints of ``tokens``: EOS tokens skipped, up to
    the end-of-answer suffix."""
    chat, out = "", ""
    for token in tokens:
        chat += token
        if MiniGPT4Engine.contains_eos_token(token):
            continue
        if MiniGPT4Engine.is_eos(chat):
            break
        out += token
    return out


def test_library_builds_with_the_header_and_exports(lib):
    """The header is the JAX package's, byte for byte; the library exports
    its 18 functions and imports only the port's modules."""
    assert HEADER.read_bytes() == (ROOT / "minigpt4_tpu" / "c_api" / "minigpt4.h").read_bytes()
    names = re.findall(r"MINIGPT4_API [^;]*?\b(minigpt4_\w+)\(", HEADER.read_text())
    assert len(names) == 18
    for name in names:
        assert getattr(lib, name)
    src = (ROOT / "minigpt4_tpu_torch" / "c_api" / "minigpt4_capi.cpp").read_text()
    imports = re.findall(r'PyImport_ImportModule\("([\w.]+)"\)', src)
    assert imports and all(m.startswith("minigpt4_tpu_torch.") for m in imports)


def test_build_refuses_a_static_interpreter(monkeypatch):
    import sysconfig

    real = sysconfig.get_config_vars()
    monkeypatch.setattr(sysconfig, "get_config_vars",
                        lambda: dict(real, Py_ENABLE_SHARED=0, LDLIBRARY="libpython3.12.a"))
    with pytest.raises(RuntimeError, match="no shared libpython"):
        _build.python_link_flags()


def test_error_strings_and_eos_match_jax(lib, jax_lib):
    for code in range(21):
        got = lib.minigpt4_error_code_to_string(code)
        if jax_lib is not None:
            assert got == jax_lib.minigpt4_error_code_to_string(code)
        if code < 20:
            assert got.decode() == jax_error_string(code)
    for s in (b"##", b"#", b"", b"abc###", b"abc", b"###"):
        assert lib.minigpt4_contains_eos_token(s) == (11 if s == b"##" else 0)
        assert lib.minigpt4_is_eos(s) == (12 if s.endswith(b"###") else 0)
        if jax_lib is not None:
            assert lib.minigpt4_contains_eos_token(s) == jax_lib.minigpt4_contains_eos_token(s)
            assert lib.minigpt4_is_eos(s) == jax_lib.minigpt4_is_eos(s)


def test_full_chat_through_abi(lib, models, cpu, tmp_path):
    """A chat through ctypes on the CPU gives the port engine's tokens; then
    a follow-up turn, a reset, and a file image through load + preprocess +
    encode."""
    model, llm = models
    ctx = lib.minigpt4_model_load(str(model).encode(), str(llm).encode(), 0, 1337, 256, 32, False)
    assert ctx
    try:
        pix = np.zeros((3, 28, 28), np.float32)  # the fixture's image geometry
        img = CImage(pix.ctypes.data_as(ctypes.c_void_p), 28, 28, 3, 1)
        emb = CEmbedding()
        assert lib.minigpt4_encode_image(ctx, ctypes.byref(img), ctypes.byref(emb), 0) == 0
        assert emb.elements == 4 * 32  # query_length * n_embd
        assert lib.minigpt4_system_prompt(ctx, 0) == 0
        assert lib.minigpt4_begin_chat_image(ctx, ctypes.byref(emb), b"what?", 0) == 0
        token = ctypes.c_char_p()
        got = []
        for _ in range(6):
            assert lib.minigpt4_end_chat_image(ctx, ctypes.byref(token), 0, *GREEDY) == 0
            got.append(token.value.decode("utf-8"))
        assert got == _engine_tokens(model, llm, 256, 32, "what?", 6, pix)
        assert lib.minigpt4_begin_chat(ctx, b"and?", 0) == 0
        assert lib.minigpt4_end_chat(ctx, ctypes.byref(token), 0, *GREEDY) == 0
        assert lib.minigpt4_reset_chat(ctx) == 0
        lib.minigpt4_free_embedding(ctypes.byref(emb))
        assert not emb.data

        path = tmp_path / "img.png"
        Image.fromarray(np.random.default_rng(0).integers(0, 255, (30, 40, 3), np.uint8)).save(path)
        raw, pre = CImage(), CImage()
        assert lib.minigpt4_image_load_from_file(ctx, str(path).encode(), ctypes.byref(raw), 0) == 0
        assert (raw.width, raw.height, raw.channels, raw.format) == (40, 30, 3, 2)
        assert lib.minigpt4_preprocess_image(ctx, ctypes.byref(raw), ctypes.byref(pre), 0) == 0
        assert (pre.width, pre.height, pre.format) == (28, 28, 1)
        assert lib.minigpt4_encode_image(ctx, ctypes.byref(pre), ctypes.byref(emb), 0) == 0
        vals = np.ctypeslib.as_array(emb.data, shape=(emb.elements,))
        assert vals.size == 128 and np.isfinite(vals).all()
        for im in (raw, pre):
            lib.minigpt4_free_image(ctypes.byref(im))
            assert not im.data
        lib.minigpt4_free_embedding(ctypes.byref(emb))
    finally:
        assert lib.minigpt4_free(ctx) == 0


def test_failure_codes_match_jax(lib, jax_lib, models, cpu, tmp_path):
    """The reference's per-failure codes (tests/test_reference_bindings.py),
    and a session still usable after them."""
    model, llm = models
    assert not lib.minigpt4_model_load(b"/nonexistent/m.bin", str(llm).encode(), 0, 1337, 256,
                                       32, False)
    ctx = lib.minigpt4_model_load(str(model).encode(), str(llm).encode(), 0, 1337, 256, 32, False)
    try:
        bad = np.zeros(7, np.float32)
        emb = CEmbedding(bad.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 7)
        assert lib.minigpt4_begin_chat_image(ctx, ctypes.byref(emb), b"q", 0) == 9
        pix = np.zeros((3, 10, 10), np.float32)
        img = CImage(pix.ctypes.data_as(ctypes.c_void_p), 10, 10, 3, 1)
        out = CEmbedding()
        assert lib.minigpt4_encode_image(ctx, ctypes.byref(img), ctypes.byref(out), 0) == 13
        img_u8 = CImage(pix.ctypes.data_as(ctypes.c_void_p), 10, 10, 3, 2)
        assert lib.minigpt4_encode_image(ctx, ctypes.byref(img_u8), ctypes.byref(out), 0) == 14
        pre = CImage()
        assert lib.minigpt4_preprocess_image(ctx, ctypes.byref(img), ctypes.byref(pre), 0) == 16
        assert lib.minigpt4_image_load_from_file(ctx, b"/nonexistent/img.png",
                                                 ctypes.byref(pre), 0) == 5
        assert lib.minigpt4_system_prompt(ctx, 0) == 0
        token = ctypes.c_char_p()
        assert lib.minigpt4_end_chat(ctx, ctypes.byref(token), 0, *GREEDY) == 0
    finally:
        lib.minigpt4_free(ctx)
    missing = [str(tmp_path / "missing.bin").encode(), str(tmp_path / "out.bin").encode(), 13]
    assert lib.minigpt4_quantize_model(*missing) == 17  # PathDoesNotExist
    if jax_lib is not None:
        assert jax_lib.minigpt4_quantize_model(*missing) == 17


@pytest.mark.parametrize("data_type", [8, 4])  # Q8_0, Q4_0 (the fixture's rows are 32 wide)
def test_quantize_byte_equal_to_jax(lib, models, tmp_path, data_type):
    model, _ = models
    got, want = tmp_path / "port.bin", tmp_path / "jax.bin"
    assert lib.minigpt4_quantize_model(str(model).encode(), str(got).encode(), data_type) == 0
    assert jax_quantize_model(str(model), str(want), data_type) == 0
    assert got.read_bytes() == want.read_bytes()


def test_speculative_k_is_refused(lib, models, cpu, monkeypatch, capsys):
    """MINIGPT4_TPU_SPECULATIVE_K is served as the JAX host serves it: an
    integer reaches the engine (``capi_host.engine_options``) and a chat
    through the library gives the plain engine's greedy tokens; only a value
    that is not an integer is refused, failing the load."""
    from minigpt4_tpu_torch.c_api import capi_host

    model, llm = models
    args = (str(model).encode(), str(llm).encode(), 0, 1337, 256, 32, False)
    monkeypatch.setenv("MINIGPT4_TPU_SPECULATIVE_K", "four")
    assert not lib.minigpt4_model_load(*args)
    assert "expected an integer" in capsys.readouterr().err
    monkeypatch.setenv("MINIGPT4_TPU_SPECULATIVE_K", "4")
    assert capi_host.engine_options()["speculative_k"] == 4
    eng = MiniGPT4Engine(model, llm, n_ctx=256, n_batch=32, device="cpu")
    try:
        eng.system_prompt()
        eng.begin_chat("what?")
        want = [eng.end_chat(SamplingParams(temp=0.0)) for _ in range(6)]
    finally:
        eng.close()
    ctx = lib.minigpt4_model_load(*args)
    assert ctx
    try:
        assert lib.minigpt4_system_prompt(ctx, 0) == 0
        assert lib.minigpt4_begin_chat(ctx, b"what?", 0) == 0
        token = ctypes.c_char_p()
        got = []
        for _ in range(6):
            assert lib.minigpt4_end_chat(ctx, ctypes.byref(token), 0, *GREEDY) == 0
            got.append(token.value.decode("utf-8"))
        assert got == want
    finally:
        assert lib.minigpt4_free(ctx) == 0


def test_examples_main_c_streams_the_engine_text(models, tmp_path):
    """The unchanged examples/main.c, linked against the port's library, runs
    a chat in its own embedded interpreter on the CPU (asked for by
    MINIGPT4_TPU_DEVICE): its streamed text is the port engine's.  Without
    the variable the library loads on cuda, which this machine lacks, and
    the load fails: nothing falls back to the CPU."""
    model, llm = models
    exe = _build.compile_client(ROOT / "examples" / "main.c", tmp_path / "main_c")
    args = [str(exe), str(model), str(llm), "28", "10"]
    env = _build.client_env()
    proc = subprocess.run(args, env=dict(env, MINIGPT4_TPU_DEVICE="cpu"), capture_output=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    want = _streamed(_engine_tokens(model, llm, 512, 64, "what is this?", 10,
                                    np.zeros((3, 28, 28), np.float32)))
    assert want and proc.stdout.decode("utf-8") == f"encoded image -> 128 floats\n{want}\n[done]\n"
    if not torch.cuda.is_available():
        env.pop("MINIGPT4_TPU_DEVICE", None)
        proc = subprocess.run(args, env=env, capture_output=True, timeout=300)
        assert proc.returncode == 1 and b"model load failed" in proc.stderr
