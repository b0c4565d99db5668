"""The port's host models that reach the device (`waveform`)."""
