"""IQ ingestion and synthesis of the port: S16LE conversion with DC
correction (on the host, or on the device: ``convert_device``),
raw/WAV/FLAC file sources with loop semantics, block framing, live pipe
and capture sources with pacing, the raw recorder, FUNcube Dongle
control, synthetic signal generators (sine/noise/BPSK). Copies of the
JAX-free modules of :mod:`jsdr_tpu.io`, with the native C++ fast paths of
``native.py`` (the port's own build of the sources, at first use)."""

from .convert import complex_to_s16le, s16le_to_complex  # noqa: F401
from .sources import (  # noqa: F401
    FileSource, open_source, read_wav, synth_bpsk_stream, synth_noise,
    synth_sine,
)
from .framer import BlockFramer  # noqa: F401
from .recorder import RawRecorder  # noqa: F401
