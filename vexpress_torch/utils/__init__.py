"""Host-side utilities of the port: the native media runtime's bindings and
parameter helpers."""
