"""Native graphkit bindings, device timing, logging and configuration."""
