"""Multi-camera registration toolkit: analyzers, fine aligners, strategies."""
