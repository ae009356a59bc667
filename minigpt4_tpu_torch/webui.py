"""Gradio web UI on the PyTorch port, modelled on ``minigpt4_tpu/webui.py``
(the reference's webui.py): it drives the port's :class:`MiniGPT4ChatBot`.
An image upload resets the chat and encodes the image; the textbox streams
the generator's output; sliders set max tokens, temperature, top-k, top-p
and the repetition penalty; the restart button restores the first state.

gradio is optional: it is imported when the UI starts, and a missing gradio
fails there with a clear error.

    python -m minigpt4_tpu_torch.webui model.bin vicuna.bin [--device cuda] [--share]
"""

from __future__ import annotations

import argparse

from .library import MiniGPT4ChatBot

# the reference's three-part header (webui.py:13-16)
title = """<h1 align="center">minigpt4_tpu_torch Demo</h1>"""
description = """<h3>MiniGPT-4 on PyTorch and CUDA. Upload an image and start chatting!</h3>"""
article = """<div style='display:flex; gap: 0.25rem; '><a href='https://github.com/Vision-CAIR/MiniGPT-4'><img src='https://img.shields.io/badge/Github-Code-blue'></a></div>
"""

_state = {"bot": None, "image_ready": False}


def user(message, history):
    history = history or []
    history.append([message, ""])
    return "", history


def chat(history, limit=1024, temp=0.8, top_k=40, top_p=0.9, repeat_penalty=1.1):
    history = history or []
    if not _state["image_ready"]:
        yield "Please upload an image first.", history
        return
    message = history[-1][0]
    history[-1][1] = ""
    for output in _state["bot"].generate(
        message, limit=int(limit), temp=float(temp), top_k=int(top_k),
        top_p=float(top_p), repeat_penalty=float(repeat_penalty),
    ):
        history[-1][1] += output
        yield history, history


def upload_image(image, history):
    import gradio as gr

    if image is None:
        return None, None, gr.update(interactive=True), history
    history = []
    _state["bot"].upload_image(image.convert("RGB"))
    _state["image_ready"] = True
    return (
        gr.update(interactive=False),
        gr.update(interactive=True, placeholder="Type and press Enter"),
        gr.update(value="Start Chatting", interactive=False),
        history,
    )


def clear_state(history, chat_message, image):
    import gradio as gr

    _state["bot"].reset_chat()
    _state["image_ready"] = False
    return (
        [],
        gr.update(value=None, interactive=True),
        gr.update(placeholder="Upload image first", interactive=False),
        gr.update(value="Upload & Start Chat", interactive=True),
    )


def start(share: bool = False):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("gradio is required for the web UI: pip install gradio") from e

    with gr.Blocks() as demo:
        gr.Markdown(title)
        gr.Markdown(description)
        gr.Markdown(article)
        with gr.Row():
            with gr.Column(scale=1):
                image = gr.Image(type="pil")
                upload_button = gr.Button(value="Upload & Start Chat", variant="primary")
                # the reference's knob ranges, defaults and order (webui.py:75-79)
                max_tokens = gr.Slider(1, 1024, label="Max Tokens", step=1, value=128)
                temperature = gr.Slider(0.0, 1.0, label="Temperature", step=0.05, value=0.8)
                top_p = gr.Slider(0.0, 1.0, label="Top P", step=0.05, value=0.95)
                top_k = gr.Slider(0, 100, label="Top K", step=1, value=40)
                repeat_penalty = gr.Slider(0.0, 2.0, label="Repetition Penalty", step=0.1,
                                           value=1.1)
            with gr.Column(scale=2):
                chatbot = gr.Chatbot(label="MiniGPT-4")
                msg = gr.Textbox(placeholder="Upload image first", interactive=False)
                clear = gr.Button("Restart")
        history = gr.State([])
        msg.submit(user, [msg, history], [msg, history]).then(
            chat,
            [history, max_tokens, temperature, top_k, top_p, repeat_penalty],
            [chatbot, history],
        )
        upload_button.click(upload_image, [image, history], [image, msg, upload_button, history])
        clear.click(clear_state, [history, msg, image], [history, image, msg, upload_button])
    demo.queue().launch(share=share)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="minigpt4_tpu_torch web UI")
    ap.add_argument("model_path")
    ap.add_argument("llm_model_path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--share", action="store_true")
    args = ap.parse_args(argv)
    _state["bot"] = MiniGPT4ChatBot(args.model_path, args.llm_model_path, device=args.device)
    start(args.share)


if __name__ == "__main__":
    main()
