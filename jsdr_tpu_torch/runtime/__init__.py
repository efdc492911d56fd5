"""Runtime helpers of the port: device selection."""
