from .synthetic import TopicCorpus, lm_batch, make_corpus

__all__ = ["TopicCorpus", "make_corpus", "lm_batch"]
