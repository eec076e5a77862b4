"""Container header parsers the engine's lane bridges need (host code,
copied from ``aukit_tpu.containers``)."""
