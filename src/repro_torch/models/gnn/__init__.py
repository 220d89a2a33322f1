"""GIN and its host-side neighbour sampler."""
