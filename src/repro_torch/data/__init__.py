"""Input data for the port (the counterpart of ``repro.data``): the
synthetic LM stream, the memory-mapped token file, the sharded training
iterator and the audio frontend's stub frames."""
from .pipeline import (SyntheticLM, TokenFileDataset, audio_batch_stub,
                       make_train_iterator)

__all__ = ["SyntheticLM", "TokenFileDataset", "audio_batch_stub",
           "make_train_iterator"]
