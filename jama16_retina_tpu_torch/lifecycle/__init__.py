"""The lifecycle's gate vocabulary (the controller is not ported)."""
