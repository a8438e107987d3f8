"""Extensions built on the public facade (reference ``ext/``)."""
