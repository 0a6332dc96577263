"""Host-side runtime: metrics, telemetry, checkpoints and fault tolerance."""
