"""Native host runtime of the port (``ggml_io.cpp`` + ctypes bindings)."""
