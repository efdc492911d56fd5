"""Headless display reductions and renderers of the port: copies of
:mod:`jsdr_tpu.display.waterfall` and :mod:`jsdr_tpu.display.render`
(numpy only). The phase scope is not ported yet (ROADMAP.md)."""

from .render import (render_psd_ascii, render_spectrum_png,  # noqa: F401
                     render_waterfall_png, write_png_rgb)
from .waterfall import Waterfall  # noqa: F401
