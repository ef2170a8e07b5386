"""Input data for the port (the counterpart of ``repro.data``): the
audio frontend's stub frames."""
from .pipeline import audio_batch_stub

__all__ = ["audio_batch_stub"]
