"""Request sources, one module per generator kind; a traffic mix names
its kind in its ``generator`` key."""
