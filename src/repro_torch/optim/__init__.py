"""The port's optimiser side (``repro.optim``): AdamW with a cosine
schedule and global-norm clipping (``adamw``), the int8 quantiser that the
quantised pheromone store shares, and gradient compression with error
feedback around it (``compression``)."""
