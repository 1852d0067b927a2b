"""Host-side helpers: window indices, channel names, series names, stage
timing. Copies of the JAX package's helpers, held to them by the tests."""
