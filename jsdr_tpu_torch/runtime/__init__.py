"""Runtime services of the port: device selection, pub/sub, logging with
stage timers, stream-state checkpoints in the reference's format, and the
streaming Session executor."""
