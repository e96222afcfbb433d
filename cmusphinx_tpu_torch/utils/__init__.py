"""Host-side helpers: binary I/O, configuration, log-domain constants."""
