"""Host-side utilities of the port: native loader and kernel build."""
