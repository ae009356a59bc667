"""The port's clients on the CPU against the JAX package's, as
tests/test_clients.py and tests/test_webui_wiring.py drive those: the
library surface (``MiniGPT4SharedLibrary``, ``load_library``) and
``MiniGPT4ChatBot``, the CLI (``python -m minigpt4_tpu_torch.main``) against
examples/main.py, the web UI's callbacks and its event graph on
tests/fake_gradio.py, the quantizer CLI on the q8_0 / q4_0 fixtures, and the
library's ``_main`` smoke.
"""

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import build_tiny_models
from minigpt4_tpu.library import MiniGPT4ChatBot as JaxChatBot
from minigpt4_tpu.library import load_library as jax_load_library
from minigpt4_tpu.quantize import quantize_model as jax_quantize_model
from minigpt4_tpu_torch import library, quantize, webui
from minigpt4_tpu_torch import main as cli
from minigpt4_tpu_torch.library import (ImageFormat, MiniGPT4ChatBot, MiniGPT4Image,
                                        load_library)

# one intra-op thread: the suite runs several pytest-xdist workers on the same cores, where
# torch's OpenMP pools spin against each other and run ~17x slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
IMAGE = np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return build_tiny_models(tmp_path_factory.mktemp("torch_clients"))


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_clients_img") / "img.png"
    Image.fromarray(IMAGE).save(path)
    return path


def test_shared_library_surface_matches_jax(models, png):
    """Method for method against the JAX package's MiniGPT4SharedLibrary:
    file image, embedding, greedy tokens, error strings, EOS rules; the U8
    and F32 checks raise; free clears."""
    got, want = {}, {}
    for out, lib in ((got, load_library("cpu")), (want, jax_load_library())):
        ctx = lib.minigpt4_model_load(str(models[0]), str(models[1]), 0)
        img = lib.minigpt4_image_load_from_file(ctx, str(png))
        out["file"] = (np.asarray(img.data), img.width, img.height, int(img.format))
        pre = MiniGPT4Image(np.zeros((3, 28, 28), np.float32), 28, 28, 3, ImageFormat.F32)
        emb = lib.minigpt4_encode_image(ctx, pre)
        out["emb"] = emb.data
        lib.minigpt4_system_prompt(ctx)
        lib.minigpt4_begin_chat_image(ctx, emb, "what?")
        out["tokens"] = [lib.minigpt4_end_chat_image(ctx, temp=0.0) for _ in range(4)]
        lib.minigpt4_begin_chat(ctx, "and?")
        out["tokens"].append(lib.minigpt4_end_chat(ctx, temp=0.0, unknown_knob=1))
        out["names"] = [lib.minigpt4_error_code_to_string(c) for c in range(20)]
        out["eos"] = (lib.minigpt4_is_eos("abc###"), lib.minigpt4_contains_eos_token("##"))
        lib.minigpt4_free(ctx)
    assert np.array_equal(got["file"][0], want["file"][0]) and got["file"][1:] == want["file"][1:]
    assert np.abs(got["emb"] - want["emb"]).max() <= 1e-5 * np.abs(want["emb"]).max()
    assert got["tokens"] == want["tokens"]
    assert got["names"] == want["names"] and got["eos"] == want["eos"] == (True, True)

    lib = load_library("cpu")
    ctx = lib.minigpt4_model_load(str(models[0]), str(models[1]), 0)
    img = lib.minigpt4_image_load_from_file(ctx, str(png))
    pre = lib.minigpt4_preprocess_image(ctx, img)
    assert pre.data.shape == (3, 28, 28) and pre.format == ImageFormat.F32
    with pytest.raises(RuntimeError, match="ImageFormatExpectedU8"):
        lib.minigpt4_preprocess_image(ctx, pre)
    with pytest.raises(RuntimeError, match="ImageNotF32"):
        lib.minigpt4_encode_image(ctx, img)
    emb = lib.minigpt4_encode_image(ctx, pre)
    lib.minigpt4_free_image(img)
    lib.minigpt4_free_embedding(emb)
    assert img.data is None and emb.data is None
    lib.minigpt4_set_verbosity(0)
    lib.minigpt4_free(ctx)


def test_chatbot_matches_jax_chatbot(models):
    """tests/test_clients.py's chatbot case on both packages: the same
    greedy tokens after an upload, then a reset."""
    out = []
    for bot in (MiniGPT4ChatBot(str(models[0]), str(models[1]), device="cpu"),
                JaxChatBot(str(models[0]), str(models[1]))):
        try:
            bot.upload_image(Image.fromarray(IMAGE))
            assert bot.is_image_chat
            out.append(list(bot.generate("hi", limit=6, temp=0.0)))
            out.append(list(bot.generate("and?", limit=3, temp=0.0)))
            bot.reset_chat()
            assert not bot.is_image_chat and bot.embedding is None
        finally:
            bot.free()
    assert out[:2] == out[2:] and out[0]
    bot = MiniGPT4ChatBot(str(models[0]), str(models[1]), device="cpu")
    assert bot.image_size == 28  # the engine's (the JAX chatbot keeps 224)
    bot.free()


def test_cli_matches_examples_main(models, png, tmp_path, monkeypatch, capsys):
    """python -m minigpt4_tpu_torch.main and examples/main.py with the same
    flags write the same token stream; --device cpu is asked for."""
    flags = ["-m", str(models[0]), "-l", str(models[1]), "-i", str(png), "-p", "what is it?",
             "and then?", "--temp", "0.0", "--limit", "8", "--n_ctx", "256", "--verbosity", "0"]
    assert cli.main(flags + ["--device", "cpu", "--tokens-out", str(tmp_path / "port.txt")]) == 0
    printed = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["main.py", *flags, "--tokens-out",
                                      str(tmp_path / "jax.txt")])
    runpy.run_path(str(ROOT / "examples" / "main.py"), run_name="__main__")
    got, want = (tmp_path / "port.txt").read_text(), (tmp_path / "jax.txt").read_text()
    assert got == want and got.count("### end of turn") == 2
    assert "> what is it?" in printed and "> and then?" in printed


def test_cli_refuses_speculative_options(models, png, tmp_path):
    """--speculative-k is served: a greedy run writes the plain run's
    tokens, turn for turn; a width past the flash-decode limit (32) is
    refused with the JAX engine's error."""
    flags = ["-m", str(models[0]), "-l", str(models[1]), "-i", str(png), "-p", "what is it?",
             "and then?", "--temp", "0.0", "--limit", "24", "--n_ctx", "256", "--verbosity",
             "0", "--device", "cpu"]
    runs = []
    for k in ("0", "4"):
        out = tmp_path / f"k{k}.txt"
        assert cli.main(flags + ["--speculative-k", k, "--tokens-out", str(out)]) == 0
        runs.append(out.read_text())
    assert runs[0] == runs[1] and runs[0].count("### end of turn") == 2
    with pytest.raises(ValueError, match="verify-block limit"):
        cli.main(flags + ["--speculative-k", "33"])


def test_cli_context_shift_runs_past_n_ctx(models, png, tmp_path):
    """--ctx-shift: an answer that fills the context keeps going where the
    same run without it stops."""
    counts = []
    for shift in ([], ["--ctx-shift"]):
        out = tmp_path / f"tokens{len(shift)}.txt"
        assert cli.main(["-m", str(models[0]), "-l", str(models[1]), "-i", str(png), "-p", "hi",
                         "--temp", "0.0", "--limit", "120", "--n_ctx", "224", "--verbosity", "0",
                         "--device", "cpu", "--tokens-out", str(out), *shift]) == 0
        counts.append(len(out.read_text().splitlines()) - 1)
    assert counts[0] < 60 < counts[1]


def test_webui_callbacks(models, monkeypatch):
    """tests/test_clients.py's callback case on the port's web UI (a stub
    stands in for gr.update)."""
    import types

    monkeypatch.setitem(sys.modules, "gradio", types.SimpleNamespace(update=lambda **kw: dict(kw)))
    monkeypatch.setitem(webui._state, "bot",
                        MiniGPT4ChatBot(str(models[0]), str(models[1]), device="cpu"))
    monkeypatch.setitem(webui._state, "image_ready", False)
    _, hist = webui.user("hi", None)
    assert list(webui.chat(hist, limit=4, temp=0.0))[0][0] == "Please upload an image first."
    ret = webui.upload_image(Image.fromarray(IMAGE), hist)
    assert webui._state["image_ready"] and ret[-1] == []
    _, hist = webui.user("what is this?", [])
    streamed = list(webui.chat(hist, limit=4, temp=0.0))
    assert streamed and all(isinstance(h[-1][-1][1], str) for h in streamed)
    cleared = webui.clear_state(hist, None, None)
    assert cleared[0] == [] and not webui._state["image_ready"]
    webui._state["bot"].free()


def test_webui_event_graph_on_fake_gradio(models, monkeypatch):
    """tests/test_webui_wiring.py on the port: start() builds its Blocks on
    the structural gradio fake and the harness fires its events."""
    import fake_gradio as fg

    monkeypatch.setitem(sys.modules, "gradio", fg)
    fg.LAUNCHED.clear()
    monkeypatch.setitem(webui._state, "bot",
                        MiniGPT4ChatBot(str(models[0]), str(models[1]), device="cpu"))
    monkeypatch.setitem(webui._state, "image_ready", False)
    webui.start(share=False)
    assert fg.LAUNCHED and fg.LAUNCHED[-1].get("share") is False
    h = fg.Harness(fg.LAUNCHED[-1]["blocks"])
    sliders = {c.kwargs.get("label"): c for c in h.blocks.components if c.kind == "Slider"}
    assert set(sliders) == {"Max Tokens", "Temperature", "Top P", "Top K", "Repetition Penalty"}
    assert (sliders["Temperature"].value, sliders["Top P"].value, sliders["Top K"].value) == (
        0.8, 0.95, 40)
    msg, image, chatbot = h.find("Textbox"), h.find("Image"), h.find("Chatbot")
    buttons = [c for c in h.blocks.components if c.kind == "Button"]
    upload_btn = next(b for b in buttons if "Upload" in str(b.value))
    clear_btn = next(b for b in buttons if b is not upload_btn)
    image.value = Image.fromarray(IMAGE)
    h.fire(upload_btn.events[0])
    assert webui._state["image_ready"] and msg.kwargs.get("interactive") is True
    sliders["Max Tokens"].value = 4
    sliders["Temperature"].value = 0.0
    msg.value = "what is this?"
    h.fire(msg.events[0])
    assert h.last_stream_len >= 1
    hist = chatbot.value
    assert hist[-1][0] == "what is this?" and isinstance(hist[-1][1], str) and hist[-1][1]
    h.fire(clear_btn.events[0])
    assert not webui._state["image_ready"] and msg.kwargs.get("interactive") is False
    webui._state["bot"].free()


def test_webui_main_takes_the_jax_flags_and_device(monkeypatch):
    """The web UI's command line is the JAX web UI's (two paths, --share)
    plus --device, which reaches the chatbot; it has no engine options."""
    made, started = [], []
    monkeypatch.setattr(webui, "MiniGPT4ChatBot", lambda *a, **kw: made.append((a, kw)))
    monkeypatch.setattr(webui, "start", started.append)
    monkeypatch.setitem(webui._state, "bot", None)
    webui.main(["m.bin", "l.bin", "--device", "cpu", "--share"])
    assert made == [(("m.bin", "l.bin"), {"device": "cpu"})] and started == [True]
    with pytest.raises(SystemExit):
        webui.main(["m.bin", "l.bin", "--ctx-shift"])


@pytest.mark.parametrize("name", ["q8_0", "q4_0"])
def test_quantize_cli_byte_equal_to_jax(models, tmp_path, name):
    from minigpt4_tpu_torch.formats import DataType

    got, want = tmp_path / "port.bin", tmp_path / "jax.bin"
    assert quantize.main([str(models[0]), str(got), name]) == 0
    assert jax_quantize_model(str(models[0]), str(want), DataType[name.upper()]) == 0
    assert got.read_bytes() == want.read_bytes()


def test_quantize_cli_missing_input(tmp_path, capsys):
    assert quantize.main([str(tmp_path / "missing.bin"), str(tmp_path / "out.bin"), "q8_0"]) == 17
    assert "PathDoesNotExist" in capsys.readouterr().err


def test_library_main_smoke(models, png, capsys):
    library._main([str(models[0]), str(models[1]), "-i", str(png), "-p", "hi,and?",
                   "--device", "cpu", "--limit", "4"])
    out = capsys.readouterr().out
    assert "> hi" in out and "> and?" in out


@pytest.mark.parametrize("ftype", ["f16", "f32"])
def test_convert_byte_equal_to_jax(tmp_path, ftype):
    """``minigpt4_tpu_torch.convert`` on tests/test_clients.py's checkpoint
    writes the JAX converter's bytes, through the function and the CLI."""
    import test_clients
    from minigpt4_tpu.convert import convert as jax_convert
    from minigpt4_tpu_torch import convert

    ckpt, _ = test_clients.TestConverter()._torch_checkpoint(tmp_path)
    want = jax_convert(ckpt, tmp_path / f"jax-{ftype}.bin", ftype=ftype,
                       qformer_config={"num_attention_heads": 2})
    got = convert.convert(ckpt, tmp_path / f"port-{ftype}.bin", ftype=ftype,
                          qformer_config={"num_attention_heads": 2})
    assert got.read_bytes() == want.read_bytes()
    cli_out = tmp_path / f"cli-{ftype}.bin"
    convert.main([str(ckpt), "-o", str(cli_out), "--ftype", ftype])
    assert cli_out.read_bytes() == jax_convert(ckpt, tmp_path / "jax-cli.bin",
                                               ftype=ftype).read_bytes()


def test_quantize_all_byte_equal_to_jax(models, tmp_path):
    """``minigpt4_tpu_torch.quantize_all`` writes the JAX tool's file names,
    each byte-equal to the JAX tool's."""
    from minigpt4_tpu import quantize_all as jax_quantize_all
    from minigpt4_tpu_torch import quantize_all

    got, want = tmp_path / "port", tmp_path / "jax"
    rc_got = quantize_all.main([str(models[0]), str(got)])
    rc_want = jax_quantize_all.main([str(models[0]), str(want)])
    assert rc_got == rc_want
    names = sorted(p.name for p in want.iterdir())
    assert names and sorted(p.name for p in got.iterdir()) == names
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
