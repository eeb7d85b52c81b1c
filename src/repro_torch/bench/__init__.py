"""The paper's tables (:mod:`.tables`) and figures (:mod:`.figures`) on the port."""
