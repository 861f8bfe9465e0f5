# The paper's primary contribution — implement the SYSTEM here
# (scheduler, optimizer, data path, serving loop, etc.) in the
# host framework. Add sibling subpackages for substrates.
#
# Shared placement/budget state lives in core.ledger.DeviceLedger (one
# source of truth for both actuators and admission); import it from here
# for convenience.
from repro_torch.core.ledger import DeviceLedger, LedgerEntry, LedgerError  # noqa: F401
