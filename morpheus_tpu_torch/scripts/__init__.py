"""Run tooling of the port: the supervised full-budget run, the multi-scene
launcher, the quality A/B and the wall-clock report."""
