"""Host utilities of the port: prediction tracing, the error taxonomy, sun
times and the legacy BirdNET-Go database readers."""
