"""The host loop and the per-model device step of the port."""
