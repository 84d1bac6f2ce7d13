"""Host utilities of the port: prediction tracing, the error taxonomy, sun
times, the legacy BirdNET-Go database readers, and what the app builds at
start: health checks and the error ring, logging, the event bus,
telemetry, the circuit breaker, the HTTP client, the resource monitors,
the bounded CUDA probe and the BLAS pool's size."""
