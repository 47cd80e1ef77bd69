"""Optimiser-side helpers of the port (``repro.optim``): so far only the
int8 quantiser that the quantised pheromone store shares."""
