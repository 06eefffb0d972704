"""Host-side planning, engines and the solver of the port."""
