"""The four assigned recsys models and their embedding substrate."""
