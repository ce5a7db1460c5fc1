"""Observability: span tracing + Chrome-trace export (see tracer.py)."""

from .export import (chrome_trace_events, export_chrome_trace,
                     validate_chrome_trace)
from .tracer import Span, Trace, Tracer

__all__ = ["Span", "Trace", "Tracer", "chrome_trace_events",
           "export_chrome_trace", "validate_chrome_trace"]
