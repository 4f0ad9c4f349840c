"""Native graphkit bindings and device timing."""
