"""Host utilities of the port: prediction tracing."""
