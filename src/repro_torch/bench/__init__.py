"""The paper's tables on the port (:mod:`.tables`)."""
