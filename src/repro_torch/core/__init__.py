"""The colony: sampling, TSP substrate, pheromone, construction, engine."""
