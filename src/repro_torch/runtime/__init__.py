"""Serving runtime: engine, steps, scheduler, telemetry, sampling."""
