"""Static bounds of a run's configuration."""
