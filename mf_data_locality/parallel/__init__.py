"""Multi-device distribution: domain decomposition over a device mesh."""
