"""Host checks of the port's kernel geometry."""
