"""Serving runtime: pool, engines, scheduler and the SLO driver."""
