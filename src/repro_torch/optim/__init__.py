"""Optimiser-side helpers of the port (``repro.optim``): the int8
quantiser that the quantised pheromone store shares, and gradient
compression with error feedback around it."""
