"""Serving runtime: engine, steps, scheduler, telemetry, sampling, and the
cluster layer over engine replicas (router, disaggregated handoff,
autoscaler, fault injection)."""
