"""The port's C ABI bridge (`bridge`), the module the port's libzl.so calls."""
