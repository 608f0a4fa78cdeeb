"""Native host code of the port: the C++ audio pipeline (native_audio)."""
