"""The brotli and catbrotli command lines."""
