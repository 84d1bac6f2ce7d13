"""Card-only diagnostics of the port: a profile of the served device step
(``profile_step``) and the mel kernel's time broken down by stage
(``mel_breakdown``). Each is run as ``python3 -m`` on a machine with a CUDA
card; importing them does nothing. Also the smoke's helpers: timing, the
MBConv cases, and the full-scale replicas of imported artifacts
(``replicas``)."""
