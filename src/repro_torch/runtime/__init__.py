"""Host-side runtime instrumentation."""
