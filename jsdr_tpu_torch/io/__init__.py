"""IQ ingestion and synthesis of the port: S16LE conversion with DC
correction, raw/WAV/FLAC file sources with loop semantics, synthetic
signal generators (sine/noise/BPSK). Copies of the JAX-free modules of
:mod:`jsdr_tpu.io`; the rest of that package is not ported yet
(ROADMAP.md)."""

from .convert import complex_to_s16le, s16le_to_complex  # noqa: F401
from .sources import (  # noqa: F401
    FileSource, open_source, read_wav, synth_bpsk_stream, synth_noise,
    synth_sine,
)
