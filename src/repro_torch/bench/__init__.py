"""The paper's tables (:mod:`.tables`) and figures (:mod:`.figures`) on the
port, and :mod:`.run`, the driver that runs them in the reference's order."""
