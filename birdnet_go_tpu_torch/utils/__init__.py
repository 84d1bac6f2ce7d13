"""Host utilities of the port: prediction tracing and the error taxonomy."""
