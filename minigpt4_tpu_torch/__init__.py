"""minigpt4_tpu_torch — the MiniGPT-4 inference path of ``minigpt4_tpu`` on
PyTorch and CUDA, with hand-written kernels for NVIDIA Hopper (sm_90a).

Pipeline: image -> EVA-CLIP ViT-G -> BLIP-2 Q-Former -> linear projection
-> Vicuna/LLaMA decoder, reading the same ggml container and llama.cpp
model files.  The file formats (``formats``), tokenizer, utilities and
image preprocessing are this package's own NumPy copies of the JAX
package's host code; this package imports neither JAX nor ``minigpt4_tpu``.
"""

__version__ = "0.1.0"
