"""Transport: ctypes bindings to the port's own libtdr."""
