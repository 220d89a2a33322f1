from .synthetic import TopicCorpus, make_corpus

__all__ = ["TopicCorpus", "make_corpus"]
