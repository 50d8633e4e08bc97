"""repro_torch.data — the synthetic LM stream (port of ``repro.data``)."""

from .pipeline import data_iterator, synth_batch

__all__ = ["data_iterator", "synth_batch"]
