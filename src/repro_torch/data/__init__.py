from .synthetic import TopicCorpus, lm_batch, make_corpus, random_graph, recsys_batch

__all__ = ["TopicCorpus", "make_corpus", "lm_batch", "recsys_batch", "random_graph"]
