"""The native (C++) dataset parser of the port, bound with ctypes."""
