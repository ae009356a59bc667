"""Training-side modules of the port: so far the inference half of the
draft head (``draft.py``)."""
